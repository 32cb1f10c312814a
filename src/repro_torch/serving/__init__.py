"""Serving data plane (port of `repro/serving`)."""
