"""Multi-device runs over ``torch.distributed``: the process group and the
mesh (:mod:`.mesh`), the counted collectives (:mod:`.audit`) and
sequence-parallel extraction (:mod:`.sp`). Counterpart of
``amcpy_tpu/parallel``; its ``batch_sharding`` and ``replicated`` have no
counterpart (a rank holds plain tensors, its own rows or a whole copy), and
:func:`shard_rows` takes the place of ``shard_batch``."""

from amcpy_tpu_torch.parallel.mesh import init_distributed, make_mesh, shard_rows

__all__ = [
    "make_mesh",
    "shard_rows",
    "init_distributed",
]
