"""Serving layer of the port: the batching ``QueryServer``, its HTTP
front end, the epoch-keyed result cache, the robustness policy and the
fault injector whose seams the engine, the live catalog and the
durability layer fire. Exports what ``repro.serve`` exports."""
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.engine import (IngestRequest, QueryRequest,
                                      QueryResponse, QueryServer,
                                      merge_shard_results)
from repro_torch.serve.faults import FaultInjector, FaultSpec
from repro_torch.serve.http import HttpFrontEnd
from repro_torch.serve.policy import (ERROR_STATUS, AdmissionQueue,
                                      CompactionFailed, DeadlineExceeded,
                                      EngineError, Overloaded,
                                      PersistenceError, RateLimited,
                                      RecoveryError, RetryPolicy,
                                      ServerClosed, TokenBucket,
                                      TransientDeviceError, deadline_after,
                                      deadline_remaining, http_status_for)

__all__ = ["QueryRequest", "QueryResponse", "IngestRequest", "QueryServer",
           "merge_shard_results",
           "ResultCache", "HttpFrontEnd",
           "FaultInjector", "FaultSpec",
           "AdmissionQueue", "RetryPolicy", "TokenBucket",
           "EngineError", "DeadlineExceeded", "TransientDeviceError",
           "CompactionFailed", "PersistenceError", "RecoveryError",
           "Overloaded", "RateLimited", "ServerClosed",
           "ERROR_STATUS", "http_status_for",
           "deadline_after", "deadline_remaining"]
