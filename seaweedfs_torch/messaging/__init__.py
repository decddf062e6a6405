"""Pub/sub messaging: the broker (its HTTP and gRPC faces), its client,
and the Kafka wire client with its in-repo broker."""

from .broker import BrokerServer, run_broker  # noqa: F401
from .client import Publisher, Subscriber  # noqa: F401
