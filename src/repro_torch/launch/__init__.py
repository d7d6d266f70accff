"""Process launch for multi-rank runs (``ranks.spawn_ranks``)."""
