"""Configuration, ingest counters and stage timing."""
