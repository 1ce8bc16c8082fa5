"""Genomic records, shards, callsets and the fixture source."""
