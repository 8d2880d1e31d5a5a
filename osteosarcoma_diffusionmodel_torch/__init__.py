"""PyTorch/CUDA port of osteosarcoma_diffusionmodel_tpu for NVIDIA Hopper.

Imports torch, numpy, scipy and the standard library only; the JAX
package is the reference it is tested against, never imported here.
"""
