"""Data- and model-parallel training over a ``torch.distributed`` mesh
(counterpart of ``transmogrifai_tpu/parallel/``): ``mesh.py`` (the mesh, the
ambient context, row placement and its content cache), ``collectives.py``
(every cross-rank call), ``distributed.py`` (process-group bootstrap and the
global mesh) and ``wide.py`` (column-sharded statistics and the gram ring)."""
