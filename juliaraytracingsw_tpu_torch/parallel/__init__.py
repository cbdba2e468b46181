"""Multi-process paths (port of ``parallel/``): the mesh over
``torch.distributed`` (``mesh``), the slab FFT (``fft``), the slab-sharded
flow models with their coupled frame (``sharded``, ``sharded_rsw``), the
cluster and sweep launcher (``launcher``) and the multi-process dry run
(``dryrun``)."""
