"""Process launch and the launchers of the port: ranks
(``ranks.spawn_ranks``), the mesh's groups and the production meshes
(``mesh``), the training CLI (``train``) and the dry-run of the production
meshes on the host (``specs``, ``analysis``, ``dryrun``)."""
