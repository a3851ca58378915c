"""Parallel strategies of the port: data-parallel gradient sync, ZeRO-1/3
sharded data parallelism and the single-device attention oracle."""

from . import gradsync, sequence, zero  # noqa: F401
