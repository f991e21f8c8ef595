"""PyTorch/CUDA port of gluon_e2e_asr_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout; imports torch, never jax.
"""
