"""Tensor, expert, pipeline and context parallelism over a
``torch.distributed`` group.

Port of ``vptq_tpu/parallel/`` (``distributed.py``, ``tp.py``,
``expert_parallel.py``, ``pipeline.py``, ``ring.py``, and the mesh of
``sharding.py``). One process per rank, each holding only its own shard:
``mesh.py`` names the ranks' data × model layout, ``tp.py`` places a
rank's shard and runs ``models.llama.forward`` over it (and a prefill
split over the data axis, ``prefill_cp``, whose attention is
``ring.py``'s), ``pipeline.py`` puts groups of blocks on their own
devices or tensor-parallel groups, and ``distributed.py`` holds the
process group, the collectives the forward calls and the point-to-point
transfers. ``models/llama.py`` reads ``distributed.py`` and ``ring.py``,
and ``tp.py`` and ``pipeline.py`` read ``models/llama.py``, so the names
below are imported when first asked for, as JAX's
``parallel/__init__.py`` exports them.
"""

import importlib

__all__ = [
    "PipelineRunner",
    "TPPipelineRunner",
    "forward_tp",
    "make_mesh",
    "pp_stage_of",
    "prefill_cp",
    "ring_attention",
    "shard_cache_tp",
    "tp_place_model",
]

_HOME = {
    "PipelineRunner": "pipeline",
    "TPPipelineRunner": "pipeline",
    "pp_stage_of": "pipeline",
    "ring_attention": "ring",
    "make_mesh": "mesh",
    "forward_tp": "tp",
    "prefill_cp": "tp",
    "shard_cache_tp": "tp",
    "tp_place_model": "tp",
}


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_HOME[name]}")
    return getattr(module, name)
