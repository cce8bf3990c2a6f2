# podlint: skip-file -- PyTorch port; the JAX trace rules do not apply
"""Port of ``repro.launch``: command-line launchers, device meshes
(``mesh``), the sharding rules (``sharding``) and the dry-run on
placeholder ranks (``dryrun``, its cells' inputs in ``inputs``, the
collective counts in ``hlo_stats``)."""
