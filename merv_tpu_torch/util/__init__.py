"""Host-side utilities of the training path: collation, sampling, seeding."""
