"""Parallel strategies of the port: data-parallel gradient sync, ZeRO-1/3
sharded data parallelism, the two-level (dcn x ici) collectives and the
single-device attention oracle."""

from . import gradsync, hierarchical, sequence, zero  # noqa: F401
