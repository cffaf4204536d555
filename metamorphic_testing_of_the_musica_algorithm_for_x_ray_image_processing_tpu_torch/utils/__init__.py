"""Host-side utilities of the port: raw/BMP IO, the debug dump with its
renders and ``StageTimer``, the HTML report and the HTTP viewer."""
