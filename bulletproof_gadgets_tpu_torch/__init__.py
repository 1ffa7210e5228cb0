"""bulletproof_gadgets_tpu_torch — the PyTorch + CUDA port of
bulletproof_gadgets_tpu (Bulletproofs R1CS gadgets over Ristretto255 with
the `.gadgets` mini-language), for NVIDIA Hopper.

Layers (the JAX package's layout and module names):
  utils/   Keccak/STROBE/Merlin transcript (the plain version of capi's),
           conversions, RNG, profiling (torch.profiler traces, phase timers)
  core/    scalars, Ristretto group, generators, R1CS prover/verifier, IPA,
           proof serialization, op-recording constraint system
  ops/     F_p and F_l limb arithmetic and curve ops (plain torch), the
           device MSM, the device inner-product argument and table fold,
           their kernel wrappers, engine wiring
  csrc/    the CUDA kernels (field.cuh, msm_kernels.cu, ipa_fold.cu);
           native/ builds them
  models/  the gadget zoo + native MiMC
  lang/    .gadgets/.inst/.wtns/.coms mini-language compiler + orchestrators
           (one proof: lang.prove / lang.verify; a batch of witnesses of
           one circuit in lockstep: lang.batch)
  cli/     prover / verifier command-line entry points, the HTTP proof
           service (serve)
  capi/    the C libraries, built with cc at first use: the Merlin
           transcript the entry points run, the C ABI (ffi.py is its Python
           half) and the JNI layer over it

Importing the package touches no device.  The entry points
(lang.prove.prove, lang.verify.verify, lang.batch.prove_batch and
verify_batch) take `device=`; without it they use the device given to
`ops.engine.register`, else CUDA (raising where CUDA is missing).
"""

__version__ = "0.1.0"
