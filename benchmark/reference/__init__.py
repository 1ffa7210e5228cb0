"""The benchmark's plain reference: a verifier of `.gadgets` proofs and
MiMCHash-256b, which imports nothing of the program under test.

core/, utils/, models/ and lang/ are a frozen copy of the host code of the
JAX package (bulletproof_gadgets_tpu: plain Python integers, no JAX), cut
to the verifier's side: dalek's R1CS verifier reduced to the scalars of
its one multiscalar check (core/r1cs.py), the inner-product argument's
verification scalars (core/ipa.py), the constraint system rebuilt from the
statement and .coms (lang/verify.py), and the native MiMC.  New here:
core/curve_torch.py, the curve arithmetic in plain PyTorch that derives
the generators and sums the check on the card, and lang/verify.verify_many.
"""
