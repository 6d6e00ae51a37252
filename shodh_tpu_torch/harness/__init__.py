"""Eval-harness hooks that the recall path reads (port of ``shodh_tpu/harness``)."""
