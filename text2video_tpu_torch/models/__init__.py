"""The pose2frame generator networks."""
