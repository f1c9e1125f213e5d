"""CPU tests of the benchmark: ``python -m pytest perfbench/tests``; the
tests marked ``gpu`` need a card."""
