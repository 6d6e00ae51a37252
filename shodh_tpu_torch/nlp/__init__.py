"""Token folding for the hash embedder (the port's own copies of
``shodh_tpu/nlp``): abbreviation folds, norm and lemma tables, the stemmer."""
