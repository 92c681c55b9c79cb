"""Distributed queue orchestration: worker probing, prompt rewrite and
dispatch fan-out."""
