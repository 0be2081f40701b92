"""The cell axis over several devices (`sharding`) and NetCDF output in
one file per block of cells (`io_shards`)."""
