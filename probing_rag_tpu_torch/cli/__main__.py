from probing_rag_tpu_torch.cli.main import main

main()
