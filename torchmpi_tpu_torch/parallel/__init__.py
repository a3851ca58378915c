"""Parallel strategies of the port: data-parallel gradient sync, ZeRO-1/3
sharded data parallelism, the two-level (dcn x ici) collectives, the
asynchronous parameter server and the single-device attention oracle."""

from . import gradsync, hierarchical, ps, sequence, zero  # noqa: F401
