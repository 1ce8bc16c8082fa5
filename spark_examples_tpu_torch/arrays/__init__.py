"""Host-side window building for the sparse Gramian engine."""
