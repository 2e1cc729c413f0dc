"""Run control of the port: SIGTERM handling (multi-process training is
ROADMAP item 13)."""
