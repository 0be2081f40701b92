"""The cell axis over several devices (`sharding`), the batch-wide
decisions voted over its shares (`votes`), and NetCDF output in one file
per block of cells (`io_shards`)."""
