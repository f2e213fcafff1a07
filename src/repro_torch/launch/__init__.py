"""Entry points of the port's language model: the step functions
(``steps``) and the continuous-batching server (``serve``)."""
