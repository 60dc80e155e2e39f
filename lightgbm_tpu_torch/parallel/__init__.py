"""Sharded training on ``torch.distributed`` (counterpart of
``lightgbm_tpu/parallel/``).

A rank is one process (or, in the CPU tests, one thread) that owns one
device; ranks meet in a ``torch.distributed`` process group that every
collective takes explicitly (``collectives.py``).  ``network.py`` starts
the default group from the reference's machine list; ``learners.py``
lays the rows or the features out over the ranks and builds the
data-, feature- and voting-parallel growers; ``dist_data.py`` builds a
rank's Dataset from its own rows with bin mappers that every rank
agrees on.
"""
