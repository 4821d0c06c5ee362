"""Pose-graph generators of the benchmark, made from a seed (host numpy)."""
