"""Small utilities: device resolution, seeding, profiling, config."""
