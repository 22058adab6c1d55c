"""The benchmark's harness: finds a cell's parts by name, runs its window,
reads its spans and its device trace, and checks its outputs."""
