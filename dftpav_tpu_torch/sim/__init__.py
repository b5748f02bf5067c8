"""Closed-loop simulation pieces: so far the moving obstacles and their
surround-trajectory fit (the rest is ROADMAP.md Queue 1 item 11)."""
