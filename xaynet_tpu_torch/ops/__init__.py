"""Compute for the PET hot loops.

- ``limbs`` — host (numpy) modular limb arithmetic and the staging codecs
- ``dd`` — vectorized double-double arithmetic for the fixed-point codec
- ``fold`` — planar limb ops and the batch fold (kernel K1)
- ``chacha`` — ChaCha20 keystream and the chop/accept rule (plain torch)
- ``kernels`` — the CUDA kernels K1/K2: build, load, launch, plain versions
- ``masking`` — protocol-level device ops (derive/sum masks, unmask)
"""
