"""The benchmark's own tests: ``python3 -m pytest port_bench/tests``
(on the card, ``-m gpu`` runs the control at the cells' own sizes)."""
