"""Cost and trace tooling: the op recorder, its cost count and the H100
roofline."""
