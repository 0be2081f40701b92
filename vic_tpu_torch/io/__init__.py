"""Readers and writers of the reference's file formats."""
