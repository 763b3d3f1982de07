"""Test and benchmark models (counterparts of ``diffsol_tpu.models``)."""
