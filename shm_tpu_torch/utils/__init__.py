"""Artifact IO and checkpoint reading."""
