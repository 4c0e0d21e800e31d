"""Scene I/O codecs and film output sinks (counterpart of
``phosphorus_mk2_tpu/io/``: host numpy code, no device)."""
