"""The benchmark's harness: manifest lookup, traffic and weights from the
seed, spans and trace reduction, the yardstick's arithmetic and the
comparison that decides ``correct``."""
