"""Participant bookkeeping of the distributed tiers (the multi-GPU mesh
is not ported yet: ROADMAP.md, Queue 1 item 6)."""
