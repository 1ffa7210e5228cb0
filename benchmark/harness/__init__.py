"""The benchmark's harness: cells, traffic, spans and trace, and the
comparison that decides `correct` (see ../README.md)."""
