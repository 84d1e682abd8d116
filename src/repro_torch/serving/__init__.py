"""Compartmentalized model serving on the port: weight pushes as log
writes, inference as leaderless reads, continuous batching."""
