"""Device-resident streaming engines and their chunk math."""
