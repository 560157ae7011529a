"""Parameter trees, timers and writers."""
