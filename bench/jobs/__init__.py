"""Jobs: one module a kind of work a traffic mix asks for (its ``job``
key). Each has ``run(ctx)`` -> a ``JobResult`` (``bench/harness.py``)."""
