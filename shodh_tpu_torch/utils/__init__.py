"""Host utilities (the port's own copies of ``shodh_tpu/utils``): content
hashing, the scoring clock, geohash."""
