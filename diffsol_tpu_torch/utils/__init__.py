"""Helpers around a solve (counterpart of ``diffsol_tpu.utils``)."""

from .stats import stats_dict, stats_json  # noqa: F401
