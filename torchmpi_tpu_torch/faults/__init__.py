"""The port's fault layer: so far only the per-peer health ledger
(:mod:`.health`) that the serving router needs.  Injection, chaos plans
and recovery are ROADMAP queue A, item 10.  Nothing imports this package
unless it is used."""
