"""Launch drivers of the port: LM serving (``serve``), the ViT train step
(``steps``) and its loop and CLI (``train``)."""
