"""Retry and backoff of the cross-host RPCs (resilience/policy.py)."""
