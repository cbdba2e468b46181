"""Rolling HDF5 outputs and bit-exact checkpoints (port of ``io/``)."""
