"""Networks of the port: configuration (``nn.conf``) and layers
(``nn.layers``)."""
