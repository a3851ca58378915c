"""Parallel strategies of the port: data-parallel gradient sync, ZeRO-1/3
sharded data parallelism, the two-level (dcn x ici) collectives, the
asynchronous parameter server, sequence-parallel attention with its
single-device oracle, and the expert-parallel MoE layer."""

from . import expert, gradsync, hierarchical, ps, sequence, zero  # noqa: F401
