"""Shape bucketing and the single-request dispatcher."""
