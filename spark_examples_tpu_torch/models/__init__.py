"""The PCoA pipeline driver."""
