"""Serving runtime: ServeConfig and the slot-batched DecodeServer."""
