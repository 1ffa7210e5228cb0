"""bulletproof_gadgets_tpu_torch — the PyTorch + CUDA port of
bulletproof_gadgets_tpu (Bulletproofs R1CS gadgets over Ristretto255 with
the `.gadgets` mini-language), for NVIDIA Hopper.

Layers (the JAX package's layout and module names):
  utils/   Keccak/STROBE/Merlin transcript, conversions, RNG
  core/    scalars, Ristretto group, generators, R1CS prover/verifier, IPA,
           proof serialization, op-recording constraint system
  ops/     F_p limb arithmetic and curve ops (plain torch), the device MSM
           and its kernel wrappers, engine wiring
  csrc/    the CUDA kernels (field.cuh, msm_kernels.cu); native/ builds them
  models/  the gadget zoo + native MiMC
  lang/    .gadgets/.inst/.wtns/.coms mini-language compiler + orchestrators
  cli/     prover / verifier command-line entry points

Importing the package touches no device: call
`bulletproof_gadgets_tpu_torch.ops.engine.register(device)` first.
"""

__version__ = "0.1.0"
