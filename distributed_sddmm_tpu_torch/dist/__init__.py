"""The multi-process layer (counterpart of the JAX package's ``dist/``):
one process a pod slot over ``torch.distributed``, no process holding the
whole matrix.

* :mod:`~distributed_sddmm_tpu_torch.dist.init` -- the rendezvous
  (coordinator, world size, rank), ``init_process_group``, pod identity
  (:func:`pod_info`) and a cross-process collective probe;
* :mod:`~distributed_sddmm_tpu_torch.dist.ingest` -- partitioned ingest:
  each process parses or draws only its own block rows;
* :mod:`~distributed_sddmm_tpu_torch.dist.elastic` -- elastic membership:
  a lost worker becomes checkpoint scan-back recovery at a smaller ``p``;
* :mod:`~distributed_sddmm_tpu_torch.dist.run` -- the pod runner (a
  worker's own admin port and trace shard, the merge of a run's shards).

The JAX package's ``dist/hlo.py`` scans compiled XLA for collectives that
cross hosts; the port compiles no XLA. A multi-process record's ``pod``
section (``bench/harness.py::pod_collectives``) carries the same fact from
the run itself: the communicator's collectives by axis, and how many ran
over groups spanning hosts, beside ``parallel/mesh.py::process_spans``.
"""

from distributed_sddmm_tpu_torch.dist.init import (  # noqa: F401
    PodContext,
    cross_process_probe,
    initialize,
    pod_info,
    resolve_init_kwargs,
)
