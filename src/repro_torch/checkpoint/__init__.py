"""Atomic step checkpoints and parameter-tree payloads, in the JAX
package's on-disk format."""
