"""Host utilities: stage timing and structured logging."""
