"""Frozen copies the benchmark owns: scene generation and the host COO
format (`scenes`), seeded device weights (`weights`), and the work and
roofline arithmetic (`work`). Plain numpy and torch; nothing of the port."""
