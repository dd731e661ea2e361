"""Core engines: semirings, the wavefront scheduler, sort, seeding, chain, align."""
