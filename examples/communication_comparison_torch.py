"""Fig. 6 reproduction on the PyTorch port, the twin of
communication_comparison.py: bytes exchanged per epoch, FedPC vs
FedAvg/Phong.

Prints the Eq. (8) table for the paper's two model sizes and the ASCII bar
chart of the reduction curve. Pure byte accounting: no device is used.

Run:  PYTHONPATH=src python examples/communication_comparison_torch.py
"""
from repro_torch.core.protocol import (fedavg_bytes_per_round,
                                       fedpc_bytes_per_round,
                                       reduction_vs_fedavg)

MODELS = {"ResNet50-FIXUP (35 MB)": 35e6, "U-Net (119 MB)": 119e6}


def main():
    for name, v in MODELS.items():
        print(f"\n=== {name} ===")
        print(f"{'N':>3} {'FedPC MB':>10} {'FedAvg/Phong MB':>16} "
              f"{'reduction':>10}")
        for n in range(3, 11):
            pc = fedpc_bytes_per_round(v, n) / 1e6
            avg = fedavg_bytes_per_round(v, n) / 1e6
            red = reduction_vs_fedavg(v, n)
            bar = "#" * int(red * 60)
            print(f"{n:>3} {pc:>10.1f} {avg:>16.1f} {red*100:>9.2f}% {bar}")
    print("\npaper claims: >=31.25% (N=3) ... 42.20% (N=10)")
    print(f"ours:         {reduction_vs_fedavg(35e6,3)*100:.2f}% (N=3) ... "
          f"{reduction_vs_fedavg(35e6,10)*100:.2f}% (N=10)")


if __name__ == "__main__":
    main()
