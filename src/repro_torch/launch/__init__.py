# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.launch``: command-line launchers, device meshes
(``mesh``) and the sharding rules (``sharding``)."""
