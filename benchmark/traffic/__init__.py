"""Traffic: one general generator (``generate.py``) and the mixes it
reads, one data file each (``<traffic>.json``)."""
