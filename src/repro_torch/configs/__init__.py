"""The paper's own ANN deployments (word2vec GoogleNews, GloVe Twitter)."""
