"""The port's own copies of ``shodh_tpu/nlp``: token folding for the hash
embedder, the query parser, OpenIE with the learned parser behind it, the
NER facade with its entity-type schema, and the gazetteer."""
