"""Parallel strategies of the port: data-parallel gradient sync and the
single-device attention oracle."""

from . import gradsync, sequence  # noqa: F401
