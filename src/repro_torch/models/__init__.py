"""Models: the decoder-only transformer LM (``transformer``), GraphSAGE
(``gnn``) and the recsys towers (``recsys``); ``params`` holds their
shared parameter-tree helpers."""
