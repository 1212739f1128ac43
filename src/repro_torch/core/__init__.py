"""Distributed-GAN federation core of the port: spec, approaches, flat-row
federation, engine and session (mirrors ``repro.core``)."""
