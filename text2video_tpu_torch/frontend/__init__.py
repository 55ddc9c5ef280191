"""Frontend records the pose stage consumes (timestamps, audio I/O)."""
