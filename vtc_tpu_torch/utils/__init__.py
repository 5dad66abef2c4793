"""Host-side helpers of the port: checkpoints, health checks and
dictionary figures (numpy and matplotlib only)."""
