"""Tensor and expert parallelism over a ``torch.distributed`` group.

Port of ``vptq_tpu/parallel/`` (``distributed.py``, ``tp.py`` but its
context-parallel prefill, ``expert_parallel.py``, and the mesh of
``sharding.py``). One process per rank, each holding only its own shard:
``mesh.py`` names the ranks' data × model layout, ``tp.py`` places a
rank's shard and runs ``models.llama.forward`` over it, and
``distributed.py`` holds the process group and the two collectives the
forward calls. The modules are imported by name (``from
vptq_tpu_torch.parallel import tp``): ``models/llama.py`` reads
``distributed.py``, and ``tp.py`` reads ``models/llama.py``.
"""
