"""Process launch and the training launcher of the port: ranks
(``ranks.spawn_ranks``), the data-axis group (``mesh``) and the training
CLI (``train``)."""
