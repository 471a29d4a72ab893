"""spark-rapids-tpu-torch: the PyTorch/CUDA port of spark-rapids-tpu.

The same engine as ``spark_rapids_tpu`` — logical plans tagged and lowered
onto device operators, a host engine for the rest — with device batches as
torch tensors and hand-written CUDA kernels in place of the JAX package's
Pallas kernels (``csrc/``). It imports neither ``jax`` nor
``spark_rapids_tpu``.

Entry point: ``TorchSession(conf, device="cuda").create_dataframe(table)``.
"""

__version__ = "0.1.0"

from .session import DataFrame, TorchSession  # noqa: F401,E402
