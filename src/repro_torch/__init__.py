"""PyTorch/CUDA port of the large-minibatch ResNet-50 training system.

Same module layout as the JAX package ``repro``, which stays the
reference it is tested against; this package imports ``torch`` and
numpy only, never ``jax`` or ``repro``. Entry points take an explicit
``device`` (default ``"cuda"``) and raise when no card is present,
unless the caller asks for ``device="cpu"`` (see ``repro_torch.device``).
"""
