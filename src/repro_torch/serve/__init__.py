"""Single-device multi-sensor time-surface serving."""
