"""Native host code: the C++ packer of ``Dataset()`` and the DataFrame
adapters (``packing.py``), built with g++ at first use."""
