"""Examples trained a second in ViLT-BERT's train cell
(``readers.examples_per_s``), apart from ``train_ex_per_s``: the host paces
this step, and its runs spread some twenty times as widely as
``vilt-b32``'s."""

from climbbench.metrics import readers

read = readers.examples_per_s
