"""dds_tpu_torch: the PyTorch/CUDA port of dds_tpu.

The same BFT-replicated encrypted store, with its ciphertext arithmetic on
an NVIDIA H100: plain tensor code is PyTorch, and every kernel that
`dds_tpu` wrote in Pallas for the TPU is a hand-written Hopper kernel under
`csrc/`. The package imports `torch`, never `jax`, and nothing of
`dds_tpu`: where it needs one of that package's host modules it keeps its
own trimmed copy under the same relative path, so each module has an
obvious twin to be tested against.

Entry points run on `cuda` unless the caller passes `device="cpu"`; on the
CPU every kernel wrapper runs its plain PyTorch version instead.
"""
