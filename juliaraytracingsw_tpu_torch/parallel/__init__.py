"""Multi-process orchestration (port of ``parallel/``): the sweep launcher.

The sharded flow, the mesh, the slab FFT and the cluster initialisation
are not ported yet (ROADMAP queue 1, item 13)."""
