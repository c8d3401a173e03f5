"""Core of the port: index, trainers and the search engine."""
from repro_torch.core.engine import QueryResult, SearchEngine  # noqa: F401
