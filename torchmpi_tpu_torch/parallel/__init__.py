"""Parallel strategies of the port: data-parallel gradient sync, ZeRO-1/3
sharded data parallelism, the two-level (dcn x ici) collectives, the
asynchronous parameter server, sequence-parallel attention with its
single-device oracle, the expert-parallel MoE layer, and the Megatron
tensor-parallel layers and pipeline schedules."""

from . import (expert, gradsync, hierarchical, pipeline, ps,  # noqa: F401
               sequence, tensor, zero)
