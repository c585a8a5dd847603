"""One module per kind of traffic, found by a traffic file's ``kind``:
``port_bench/kinds/<kind>.py``, whose class ``Cell`` reads the file's
parameters (see ``port_bench/cells.py``)."""
