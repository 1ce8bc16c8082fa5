"""Host-side ingest: carrier windows, dense blocks, the device feed."""
