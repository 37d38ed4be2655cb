"""PyTorch + CUDA port of the IterPro resilience stack for NVIDIA Hopper.

Laid out module for module like ``repro`` (the JAX + Pallas reference):
``configs``, ``kernels`` (plain versions in ``kernels/ref.py``, hand-written
Hopper kernels under ``kernels/csrc``), ``models``, ``core``, ``serving``
and ``launch``.  The port imports ``torch`` and never ``jax`` or anything
of ``repro``; params are plain dicts of tensors under the reference's leaf
paths, shapes and dtypes, so both packages' digest plans line up row for
row.
"""
