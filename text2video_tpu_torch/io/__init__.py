"""Keypoint tables and dictionaries, and the video containers."""
