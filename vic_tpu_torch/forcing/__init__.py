"""Forcing ingest, MTCLIM and the sub-daily disaggregation."""
