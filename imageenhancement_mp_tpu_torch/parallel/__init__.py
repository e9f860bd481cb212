"""Sharding over a device mesh: the port's counterpart of the JAX package's
``parallel/``.

``mesh`` holds the single-controller mesh (one call takes the whole batch and
returns the whole result; one thread per shard) and its collectives;
``sharding`` is batch sharding, ``spatial`` row sharding of one frame.  Import
the submodules: this package imports none of them, so ``ops`` can import
``parallel.mesh`` without a cycle.
"""
