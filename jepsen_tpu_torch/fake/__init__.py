"""In-process fake distributed systems for E2E testing without SSH or
docker: a deliberately configurable replicated KV store with injectable
partitions, pauses, kills, latency, loss, and clock skew.
"""
from jepsen_tpu_torch.fake.broker import FakeBroker
from jepsen_tpu_torch.fake.cluster import FakeCluster, Unavailable

__all__ = ["FakeBroker", "FakeCluster", "Unavailable"]
