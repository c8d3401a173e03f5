"""Plain PyTorch references, one module a family, named by each
configuration's ``reference`` key. They import nothing of the program
and compute in float32 with TF32 off, or in a stated lower precision for
the controls (``precision.py``)."""
