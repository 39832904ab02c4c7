"""The routing tier's jax-free pieces (the rest waits for ROADMAP.md
A.5)."""
