"""The plain reference of each configuration family (`second.py`) on the
frozen plain modules of `plain/`, the trainer's optimizer chains
(`optim.py`) and the first three train steps (`train.py`). It imports
nothing of the port: it works the plan, the targets and the assignment out
again from the inputs and weights the benchmark makes."""
