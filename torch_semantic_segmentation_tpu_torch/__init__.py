"""PyTorch and CUDA port of `torch_semantic_segmentation_tpu`, for one
NVIDIA H100 (Hopper, sm_90a).

It keeps the JAX package's module names, attribute paths and NHWC layout,
so weights carry over one to one (`compat.state_dict_from_jax`). Every
kernel the JAX package wrote in Pallas becomes a hand-written Hopper kernel
under `csrc/`, built at first use (`kernels`). Entry points run on the card
unless the caller passes `device="cpu"`; on the CPU a kernel's wrapper runs
its plain PyTorch version. This package imports neither JAX nor the JAX
package.
"""
